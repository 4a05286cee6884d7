"""Allow `python -m glc_tpu_torch <args>` as the `glc` command."""

import sys

from .cli import main

sys.exit(main())
