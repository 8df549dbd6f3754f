"""Host scripts of the port (run with ``python -m fsnet_tpu_torch.scripts.<name>``)."""
