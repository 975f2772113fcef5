"""The learned models of the benchmark's configurations, one module each.

A top-level group ``X`` of a configuration file is a learned model of its
cells when ``models/X.py`` exists (``registry.models``); the group holds the
model's widths and the size of its check's sample. The harness (``run.py``,
``system.py``, ``check.py``, ``control.py``) names no model: it calls each
module through these names, with ``run`` the ``run.Run`` being set up or
checked:

- ``NUMBERS``: name -> (how the worst of several scenes is taken, the side
  the limit bounds), judged after ``check.NUMBERS``, with limits of the same
  names in the configuration's ``limits``;
- ``setup(run, group) -> state``: the model's weights, made on the device
  from ``run.seed``, and its check's sample, drawn from ``run.rng``; it
  runs once ``run.survey`` is made, before the cell's features;
- ``install(opt, state)``: the model on the port's normal path of the
  ``SceneOptimizer`` ``opt``;
- ``probes(opt, state, chunk, attention_span) -> probe``: hooks that keep
  what the timed path produced into the scene's capture dict, which
  ``probe.begin_scene(capture)`` hands over before each scene;
  ``probe.close()`` restores what they replaced. ``chunk`` is the two-view
  chunk size; with ``attention_span`` each attention call gets a profiler
  span of its own;
- ``numbers(state, run, capture) -> dict``: the model's numbers against its
  own plain reference for one scene, with ``pairs_match`` 0 when the
  capture lacks part of the sample;
- ``controls(state, run) -> dict`` (optional): the readings of the model's
  controls, for ``control.py``.

A module imports the port only for the model it installs and probes."""
