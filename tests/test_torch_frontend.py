"""The JAX package's front-end and okapi unit tests on the port.

``tests/test_{parser,lexer,ir,logical}.py`` (84 cases) and
``tests/test_{schema,types,values,trees}.py`` (29 cases) are loaded from
their source with ``caps_tpu`` rewritten to ``caps_tpu_torch``
(``caps_tpu_torch/testing/suites.py``), so each case runs unedited
against the port's ``frontend/``, ``ir/``, ``logical/`` and ``okapi/``.
Each reference file becomes one class here: ``TestParser`` holds
``tests/test_parser.py``'s cases under their own names.
"""
from caps_tpu_torch.testing.suites import collect_tests, load_module

FRONTEND = ("parser", "lexer", "ir", "logical")
OKAPI = ("schema", "types", "values", "trees")
COUNTS = {"parser": 32, "lexer": 12, "ir": 25, "logical": 15,
          "schema": 6, "types": 10, "values": 7, "trees": 6}


def _suite_class(stem):
    tests = collect_tests(load_module(f"test_{stem}.py"))
    name = "Test" + stem.capitalize()
    return name, type(name, (), {n: staticmethod(f)
                                 for n, f in tests.items()})


_LOADED = {}
for _stem in FRONTEND + OKAPI:
    _name, _cls = _suite_class(_stem)
    _LOADED[_stem] = _cls
    globals()[_name] = _cls


def test_every_reference_case_is_collected():
    got = {stem: sum(1 for n in vars(cls) if n.startswith("test_"))
           for stem, cls in _LOADED.items()}
    assert got == COUNTS
    assert sum(got.values()) == 113
