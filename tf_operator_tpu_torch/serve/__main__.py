"""python -m tf_operator_tpu_torch.serve: the decode server's CLI."""

from .server import main

if __name__ == "__main__":
    import sys

    sys.exit(main())
