"""The benchmark's own tests import its modules by their names under
``portbench/`` (as ``run.py`` does), and the program from the root."""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]
