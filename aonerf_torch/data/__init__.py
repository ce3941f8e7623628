"""Data: cameras, the analytic laptop scene and its writers, the SAPIEN
loaders (train buffers through the native loader, ``aonerf_torch.native``),
the datagen CLI (``datagen``) and segmented ray selection."""
