"""The benchmark's own tests (``python -m pytest portbench/tests``): the
yardstick's counts, the inputs' determinism, the reference against the
port's CPU path, the harness driven on the CPU at a small size (planted
faults included), and the import isolation.  Tests marked ``cuda`` run the
control at the cells' own size and skip without a card."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

#: a cell at a size the CPU runs in seconds: 32 px, one augmented replica,
#: one epoch of inner steps, two lanes, three queries a class
SMALL = {"image_size": 32, "data": {"classes": 10, "per_class": 12, "base_size": 36}, "gen_examples": 1,
         "fine_tune_epoch": 1, "eval_batch": 2, "n_query": 3}
