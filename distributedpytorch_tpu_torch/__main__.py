"""``python -m distributedpytorch_tpu_torch {train,test,serve} ...``"""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
