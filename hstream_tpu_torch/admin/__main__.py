"""`python -m hstream_tpu_torch.admin`."""

import sys

from hstream_tpu_torch.admin import main

if __name__ == "__main__":
    sys.exit(main())
