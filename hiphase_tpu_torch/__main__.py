"""``python -m hiphase_tpu_torch`` runs the CLI."""

import sys

from hiphase_tpu_torch.cli import run_command

sys.exit(run_command())
