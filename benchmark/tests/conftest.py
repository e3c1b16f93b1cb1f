"""The benchmark's own tests (``python -m pytest benchmark/tests``): the
benchmark's folder and the repository's root on the import path."""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
for p in (os.path.dirname(os.path.dirname(HERE)), os.path.dirname(HERE)):
    if p not in sys.path:
        sys.path.insert(0, p)
