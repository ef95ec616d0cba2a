"""Image-processing core of the PyTorch port: the pieces the denovo3d
grid search's prep chain runs (interpolation, rotation, down-scaling and
the helix diameter estimator)."""
