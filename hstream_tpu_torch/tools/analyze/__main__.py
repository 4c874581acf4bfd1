"""`python -m hstream_tpu_torch.tools.analyze` entry point."""

import os
import sys

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))))
    from hstream_tpu_torch.tools.analyze import main

    sys.exit(main())
