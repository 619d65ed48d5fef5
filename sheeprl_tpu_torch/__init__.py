"""sheeprl_tpu_torch: the PyTorch and CUDA port of sheeprl_tpu, for NVIDIA Hopper (H100).

The JAX package ``sheeprl_tpu`` is the reference this port is held to; this
package never imports it, nor JAX. Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``. See README.md, "The PyTorch port".
"""
