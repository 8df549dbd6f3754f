"""The port's config files (``cfg_from_file`` executes them by path); the
shared pieces live in :mod:`fsnet_tpu_torch.configs.common`."""
