"""Plain PyTorch references of the served models, in float32 with TF32 off,
over the published checkpoints' keys. Nothing here imports the program,
JAX or the JAX package."""
