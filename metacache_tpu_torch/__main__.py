"""`python -m metacache_tpu_torch` == the port's CLI (main.cpp:41-106)."""
import sys

from .cli import main

sys.exit(main())
