"""Qualitative artifacts (port of the text half of
`solvingpapers_tpu/metrics/viz.py`; the image grids come with the image
families, ROADMAP A6)."""

from __future__ import annotations

import os


def save_text_sample(text: str, directory: str, step: int) -> str:
    """deepseekv3 cell 51's `generated_{step}.txt` artifact: `text`
    written to `directory` (made if missing); returns the file's path."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"generated_{step}.txt")
    with open(path, "w", encoding="utf-8") as f:
        f.write(text)
    return path
