"""Dataset generation: the datagen CLI (``generate``) and the SAPIEN
simulator backend (``sapien_backend``)."""
