"""The repository's root on the path, so that the tests import
``renderbench`` and the port from any working directory."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
