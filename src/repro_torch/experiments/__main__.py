import sys

from repro_torch.experiments.cli import main

# guarded (the reference's is not), so that importing every module of the
# package, as the import checks do, runs no command
if __name__ == "__main__":
    sys.exit(main())
