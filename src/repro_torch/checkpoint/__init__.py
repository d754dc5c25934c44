from repro_torch.checkpoint.checkpoint import save_checkpoint, load_checkpoint  # noqa: F401
