"""Math kernels in plain PyTorch: quaternions, spherical harmonics,
covariance and EWA projection, SSIM, exact KNN."""
