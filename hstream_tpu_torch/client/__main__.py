"""`python -m hstream_tpu_torch.client`."""

import sys

from hstream_tpu_torch.client import main

if __name__ == "__main__":
    sys.exit(main())
