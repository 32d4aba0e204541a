"""Measurement scripts of the port, each run as
`python -m pde_policylearning_torch.tools.<name>` (see each module)."""
import subprocess


def card_name():
    """The card's name and power limit as `nvidia-smi` reports them, or
    None where there is no nvidia-smi."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None
