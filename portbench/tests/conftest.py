"""Put the repository's root on ``sys.path``: the tests import ``portbench``
and the port from a checkout, as ``portbench/run.py`` does."""

import pathlib
import sys

ROOT = str(pathlib.Path(__file__).resolve().parents[2])
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
