"""Test harness: Bag comparison and the CREATE-string graph factory.

The port's copy of the JAX package's ``caps_tpu/testing`` assets that
the conformance harness needs (``Bag`` multiset comparison and the
``CREATE``-string factory; ref: okapi-testing, SURVEY.md §2, §4).
"""
from caps_tpu_torch.testing.bag import Bag  # noqa: F401
