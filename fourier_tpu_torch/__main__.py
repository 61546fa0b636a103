"""`python -m fourier_tpu_torch` - the CLI entry."""

import sys

from .runtime.cli import main

sys.exit(main())
