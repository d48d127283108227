"""``python -m realtimeobjectdetection_tpu_torch detect [params.json]``."""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
