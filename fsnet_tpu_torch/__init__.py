"""PyTorch/CUDA port of fsnet_tpu for NVIDIA Hopper (H100).

Mirrors ``fsnet_tpu``'s module paths and class names; imports ``torch`` and
nothing of JAX or of ``fsnet_tpu``. Entry points run on a CUDA device unless
the caller passes ``device="cpu"``. See ``fsnet_tpu_torch.entry`` for the
flagship depth model.
"""
