"""Command-line tools of the port (run with `python -m pocket_tts_tpu_torch.tools.<name>`)."""
