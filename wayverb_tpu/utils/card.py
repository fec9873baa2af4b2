"""The GPU's name and power limit, as ``nvidia-smi`` reports them.

Every number measured on a card is printed beside this line: a card set
below its maximum power limit runs slower under load.
"""

from __future__ import annotations

import subprocess

QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"]


def parse_smi_line(text: str) -> tuple:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    output → (name, power limit) of the first card."""
    lines = [ln.strip() for ln in text.strip().splitlines() if ln.strip()]
    if not lines:
        raise ValueError("no card listed by nvidia-smi")
    parts = [p.strip() for p in lines[0].rsplit(",", 1)]
    if len(parts) != 2 or not parts[0] or not parts[1]:
        raise ValueError(f"unexpected nvidia-smi line: {lines[0]!r}")
    return parts[0], parts[1]


def card_line() -> str:
    """The first card's ``name, power.limit`` line; raises without one."""
    out = subprocess.run(QUERY, capture_output=True, text=True, timeout=60,
                         check=True)
    line = out.stdout.strip().splitlines()[0].strip()
    parse_smi_line(line)
    return line
