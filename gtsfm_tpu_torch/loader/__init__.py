"""Dataset loaders (reference gtsfm/loader/): the LoaderBase contract,
the synthetic aerial survey and the Olsson format."""
