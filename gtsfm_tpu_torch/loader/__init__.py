"""Dataset loaders (reference gtsfm/loader/): the LoaderBase contract,
the synthetic aerial survey, the Olsson format and COLMAP text models."""
