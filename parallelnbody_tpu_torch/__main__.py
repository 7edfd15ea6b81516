import sys

from parallelnbody_tpu_torch.cli import main

sys.exit(main())
