"""Allow `python -m glc <args>` as the `glc` binary."""

import sys

from .cli import main

sys.exit(main())
