"""Image-processing core of the PyTorch port: the pieces the denovo3d
grid search's prep chain runs (interpolation, rotation and shift, the
Fourier filters and down-scaling, the denoisers and the helix diameter
estimator)."""
