"""`python -m hstream_tpu_torch.http_gateway`."""

import sys

from hstream_tpu_torch.http_gateway import main

if __name__ == "__main__":
    sys.exit(main())
