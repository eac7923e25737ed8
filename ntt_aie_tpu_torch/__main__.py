"""``python -m ntt_aie_tpu_torch``: the port's command line (cli.main)."""

import sys

from ntt_aie_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
