"""The benchmark's tests import `gpubench` from the checkout's root and
the program from `src/`, as `gpubench/run.py` does."""
import sys
from pathlib import Path

_ROOT = Path(__file__).resolve().parents[2]
for p in (str(_ROOT / "src"), str(_ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)
