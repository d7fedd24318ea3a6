"""The published peaks of one H100 (`peaks.json`)."""

from __future__ import annotations

import json
import os

with open(os.path.join(os.path.dirname(__file__), "peaks.json")) as _f:
    PEAKS = json.load(_f)
