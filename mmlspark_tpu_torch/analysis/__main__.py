"""``python -m mmlspark_tpu_torch.analysis`` — the port's graft-lint gate."""
import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
