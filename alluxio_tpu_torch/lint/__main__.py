import sys

from alluxio_tpu_torch.lint.runner import main

if __name__ == "__main__":
    sys.exit(main())
