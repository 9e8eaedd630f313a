"""Command-line drivers of the port (``python -m
mcmctoffitting_tpu_torch.cli.simult_fit`` / ``.csi_onebd``)."""
