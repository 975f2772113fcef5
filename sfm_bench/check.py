"""The numbers that decide ``correct``, each worked out by the plain
reference from the benchmark's own inputs and the program's outputs, and
held against its limit in the configuration file.

A scene fails when any of its numbers is outside its limit; ``correct``
holds when no scene fails. Each number is reported as its worst over the
scenes checked. ``NUMBERS`` are every cell's; a learned model's module
(``models/``) adds its own."""

from __future__ import annotations

import numpy as np
import torch

from sfm_bench import reference, registry, scene

# name -> (how the worst of several scenes is taken, the side the limit bounds)
NUMBERS = {
    "cameras_share": (min, "min"),
    "rot_max_deg": (max, "max"),
    "rot_median_deg": (max, "max"),
    "reproj_px": (max, "max"),
    "points_height": (max, "max"),
    "two_view_ok": (min, "min"),
    "averaged_rot_median_deg": (max, "max"),
    "ba_step_deg": (max, "max"),
    "ba_step_centre": (max, "max"),
}


def numbers_of(models) -> dict:
    """``NUMBERS``, then each model module's own, in that order."""
    out = dict(NUMBERS)
    for _, mod in models:
        out.update(mod.NUMBERS)
    return out


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float64)


def scene_numbers(survey: scene.Survey, result, capture: dict, two_view: dict | None) -> dict:
    """The numbers of one reconstructed scene. ``result`` is the program's
    (final scene, rotations before BA); ``capture`` what the probes kept."""
    out = {}
    sc = result.scene
    live_cam = _np(sc.camera_mask) > 0
    out["cameras_share"] = float(live_cam.sum()) / survey.num_images
    gt_R, gt_t = survey.wRi, survey.wti
    wRi, wti = _np(sc.wRi), _np(sc.wti)
    # final cameras: the similarity of their centres onto the truth
    s, Q, t = reference.umeyama(wti[live_cam], gt_t[live_cam])
    rot = reference.rotation_angle_deg(np.einsum("ij,njk->nik", Q, wRi[live_cam]), gt_R[live_cam])
    out["rot_max_deg"], out["rot_median_deg"] = float(rot.max()), float(np.median(rot))
    # points on the terrain after that similarity (share of the altitude)
    live_tr = (_np(sc.track_mask) > 0)
    X = s * _np(sc.points)[live_tr] @ Q.T + t
    dz = X[:, 2] - scene.terrain_height(survey, X[:, 0], X[:, 1])
    out["points_height"] = float(np.median(np.abs(dz)) / survey.altitude)
    live_m = (sc.meas_mask > 0) & (sc.track_mask[sc.meas_track] > 0)
    out["reproj_px"] = reference.mean_reprojection_px(sc.wRi, sc.wti, sc.cal, sc.points, sc.meas_cam,
                                                      sc.meas_track, sc.meas_uv, live_m)
    # rotation averaging: the rotations before BA (the averaged ones)
    pre = np.asarray(result.wRi_pre_ba, np.float64)
    out["averaged_rot_median_deg"] = float(np.median(reference.aligned_rotation_errors(pre[live_cam],
                                                                                      gt_R[live_cam])))
    if two_view is not None:
        ok = two_view["success"].astype(bool)
        pairs = [p for k, p in enumerate(two_view["pairs"]) if ok[k]]
        r_err, u_err = reference.two_view_errors(pairs, two_view["i2Ri1"][ok], two_view["i2Ui1"][ok], gt_R, gt_t)
        out["two_view_ok"] = float(np.mean((r_err < 5.0) & (u_err < 5.0))) if pairs else 0.0
    fin = capture.get("ba_final")
    if fin is not None:
        s_in, s_out = fin["scene_in"], fin["scene_out"]
        live = (s_in.meas_mask > 0) & (s_in.track_mask[s_in.meas_track] > 0)
        use = reference.solve_slots(s_in.meas_track, s_in.meas_cam, live, s_in.wRi.shape[0], fin["bucket_l"])
        step = reference.ba_step(s_out.wRi, s_out.wti, s_out.cal, s_out.points, s_in.meas_cam, s_in.meas_track,
                                 s_in.meas_uv, use, fin["huber_k"])
        out["ba_step_deg"], out["ba_step_centre"] = step["rot_deg"], step["centre_rel"]
    return out


def sg_reference(sd: dict, feats, pairs, keys, max_resolution: int, device, rows, block: int = 4,
                 tf32_attention: bool = False) -> tuple[dict, dict]:
    """The reference's SuperGlue on the pairs ``keys``, in float32 (TF32
    off unless ``tf32_attention`` rounds the attention products' operands):
    {pair: (md0, md1)} and {pair: attention outputs (calls, heads, rows,
    dh) at query rows ``rows``}, as float64 arrays."""
    md, attn = {}, {}
    keys = sorted(keys)
    tap_rows = torch.as_tensor(rows, device=device)
    for b0 in range(0, len(keys), block):
        ks = keys[b0:b0 + block]
        ij = [pairs[k] for k in ks]

        def side(n, field):
            return torch.as_tensor(np.stack([getattr(feats, field)[p[n]] for p in ij]), device=device)

        ones = torch.ones(len(ks), feats.uv.shape[1], device=device)
        taps = []
        with torch.no_grad():
            md0, md1 = reference.superglue_descriptors(
                sd, side(0, "descriptor"), side(1, "descriptor"),
                reference.normalize_keypoints(side(0, "uv"), max_resolution, max_resolution),
                reference.normalize_keypoints(side(1, "uv"), max_resolution, max_resolution), ones, ones, ones, ones,
                taps=taps, tap_rows=tap_rows, tf32_attention=tf32_attention)
        taps = _np(torch.stack(taps, 1))
        for n, k in enumerate(ks):
            md[k] = (_np(md0[n]), _np(md1[n]))
            attn[k] = taps[n]
    return md, attn


def _gap(got, ref) -> float:
    """The largest gap as a share of the reference's largest entry."""
    ref = np.asarray(ref, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - ref).max() / np.abs(ref).max())


def sg_numbers(sd: dict, feats, pairs, captured: dict, captured_attn: dict, max_resolution: int, device,
               rows) -> dict:
    """SuperGlue against the reference, over the captured pairs:
    ``sg_desc_err``, the largest gap of the matching descriptors, and
    ``sg_attn_err``, the largest over every attention call of the gap of
    its output at the sampled rows, each as a share of the reference's
    largest entry (of the descriptors; of that call's output). The
    descriptors are 20 times the residual stream, whose identity path
    carries the input descriptors, so attention moves them little; its own
    outputs show a change of the attention's arithmetic whole."""
    md, attn = sg_reference(sd, feats, pairs, captured, max_resolution, device, rows)
    desc = attn_err = 0.0
    for k in sorted(captured):
        desc = max([desc] + [_gap(g, r) for g, r in zip(captured[k], md[k])])
        got = captured_attn.get(k)
        if got is None or np.shape(got) != attn[k].shape:
            attn_err = float("inf")
            continue
        attn_err = max([attn_err] + [_gap(g, r) for g, r in zip(got, attn[k])])
    return {"sg_desc_err": desc, "sg_attn_err": attn_err}


def judge(per_scene: list[dict], limits: dict, numbers: dict | None = None) -> tuple[dict, list[bool]]:
    """(the worst reading of each number with its limit, whether each scene
    passed). Every number of ``numbers`` (by default those of ``NUMBERS``
    and of every model module) that a scene reports is held to its limit;
    a reading that is not a number (NaN) fails."""
    if numbers is None:
        numbers = numbers_of(registry.models())
    worst = {}
    ok = [True] * len(per_scene)
    for name, (pick, side) in numbers.items():
        vals = [s[name] for s in per_scene if name in s]
        if not vals:
            continue
        lim = limits[name]
        worst[name] = {"value": pick(vals), "limit": lim, "side": side}
        for i, s in enumerate(per_scene):
            v = s.get(name)
            if v is not None and not (v >= lim if side == "min" else v <= lim):
                ok[i] = False
    return worst, ok
