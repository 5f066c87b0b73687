"""PyTorch/CUDA port of nanodiloco_tpu for one NVIDIA H100 (see README)."""
