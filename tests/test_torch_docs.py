"""The port's guide is executable: every fenced ``python`` block of
``docs/torch/guide.md`` runs top to bottom in one namespace, as
``tests/test_docs.py`` runs the reference's ``docs/*.md`` (the port's
guide sits in its own folder, so that test does not pick it up)."""
from __future__ import annotations

import os
import re

GUIDE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "docs", "torch", "guide.md")

_FENCE = re.compile(r"```python\n(.*?)```", re.DOTALL)


def test_guide_snippets_run():
    text = open(GUIDE).read()
    blocks = _FENCE.findall(text)
    assert blocks, f"{GUIDE} has no python snippets"
    ns: dict = {}
    for i, block in enumerate(blocks):
        try:
            exec(compile(block, f"guide.md[snippet {i}]", "exec"), ns)
        except Exception as ex:  # pragma: no cover
            raise AssertionError(
                f"guide.md snippet {i} failed: {ex}\n---\n{block}") from ex


def test_guide_names_only_the_port():
    """The guide's code imports the port, never the JAX package."""
    code = "\n".join(_FENCE.findall(open(GUIDE).read()))
    assert not re.search(r"^\s*(import|from)\s+(jax|caps_tpu)\b(?!_torch)",
                         code, re.MULTILINE)
