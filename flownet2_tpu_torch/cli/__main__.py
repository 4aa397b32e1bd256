"""``python -m flownet2_tpu_torch.cli``: train, validate or run inference."""

import sys

from .main import main

if __name__ == "__main__":
    sys.exit(main())
