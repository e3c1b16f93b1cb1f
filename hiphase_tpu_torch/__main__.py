"""``python -m hiphase_tpu_torch`` runs the CLI."""

import sys

from hiphase_tpu_torch.cli import main

sys.exit(main())
