"""Command-line tools of the port (run with `python -m pocket_tts_tpu_torch.tools.<name>`)."""

import subprocess


def card_line() -> str:
    """The card's name and power limit, as `nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader` prints them (a tool's numbers stand beside it)."""
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
    except OSError as e:
        return f"nvidia-smi failed: {e}"
    lines = smi.stdout.strip().splitlines()
    return lines[0] if smi.returncode == 0 and lines else "nvidia-smi failed"
