"""openCypher TCK-subset conformance harness for the port.

The port's own copy of the JAX package's harness (``caps_tpu/tck``):
the Gherkin scenario loader, the runner with its table comparison
(in-order / any-order multisets) and the blacklist mechanism, and the
29 ``.feature`` files of the corpus.  ``blacklists/cuda.txt`` lists the
scenarios that still reach an operator or expression with no device
path; each line names it.
"""
from caps_tpu_torch.tck.runner import (  # noqa: F401
    NotPorted, Scenario, load_features, load_gaps, run_scenario,
)
