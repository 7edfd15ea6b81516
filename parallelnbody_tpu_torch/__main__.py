import sys

from parallelnbody_tpu_torch.cli import main

# Guarded: the rank launcher (parallel/mesh.py) starts its processes with
# the spawn method, which imports this module again in every rank.
if __name__ == "__main__":
    sys.exit(main())
