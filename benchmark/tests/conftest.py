"""The benchmark's own tests: CPU tests of the harness, the generators and
the checks, and card tests (marked `cuda`) that skip where there is no
card.  Run from the root of the repository:

    python -m pytest benchmark/tests -q
"""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(BENCH))
sys.path.insert(1, str(BENCH.parent))
