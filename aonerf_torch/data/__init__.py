"""Data: cameras, the analytic test scene, and the SAPIEN eval loader."""
