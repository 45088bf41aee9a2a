"""``python -m makisu_tpu_torch`` runs the command line."""

import sys

from makisu_tpu_torch.cli import main

sys.exit(main())
