"""``python -m paralleljohnson_tpu_torch`` entry point."""

import sys

from paralleljohnson_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
