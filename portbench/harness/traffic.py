"""The one general generator: a traffic mix's data file to requests.

A mix (``traffic/<mix>.json``) lists query families, each with its text,
its share of the requests, how its parameters are drawn, and the name
of the reference answer in the configuration's module.  Parameters:

- ``{"deck": [lo, hi]}``: every whole number from lo to hi once, in an
  order drawn from the seed, then again in a new order, and so on;
- ``{"plus": [name, k]}``: another parameter of the request plus k.

Families are dealt the same way: a deck of ``share`` cards per family,
shuffled anew each round.  So every seed gives each client the same
set of sizes, in another order, and runs differ by order, not by work.
Each client has its own stream, drawn from (seed, client).
"""
from __future__ import annotations

import itertools
from typing import Any, Dict, Iterator, List, Tuple

import numpy as np

Request = Tuple[int, Dict[str, Any]]   # (family index, parameters)


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """A generator for ``seed`` (any whole number) and a stream id."""
    return np.random.default_rng([seed % (1 << 64), *stream])


def _decks(rng: np.random.Generator, values: List[Any]) -> Iterator[Any]:
    while True:
        for i in rng.permutation(len(values)):
            yield values[int(i)]


def _deck_values(spec: Dict[str, Any]) -> List[int]:
    lo, hi = spec["deck"]
    return list(range(int(lo), int(hi) + 1))


def _resolve(params: Dict[str, Any], drawn: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(drawn)
    for name, spec in params.items():
        if "plus" in spec:
            base, k = spec["plus"]
            out[name] = out[base] + k
    return {name: out[name] for name in params}


def client_stream(mix: Dict[str, Any], seed: int, client: int
                  ) -> Iterator[Request]:
    """Client ``client``'s endless sequence of requests."""
    rng = rng_for(seed, client)
    fams = mix["families"]
    cards = [i for i, f in enumerate(fams) for _ in range(int(f["share"]))]
    fam_deck = _decks(rng, cards)
    decks = [{name: _decks(rng, _deck_values(spec))
              for name, spec in f.get("params", {}).items() if "deck" in spec}
             for f in fams]
    while True:
        i = next(fam_deck)
        drawn = {name: next(d) for name, d in decks[i].items()}
        yield i, _resolve(fams[i].get("params", {}), drawn)


def param_space(family: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Every parameter set the family can draw (the product of its
    decks): the warm-up runs each once, so no shape is new in the
    window."""
    params = family.get("params", {})
    names = [n for n, s in params.items() if "deck" in s]
    combos = itertools.product(*(_deck_values(params[n]) for n in names))
    return [_resolve(params, dict(zip(names, c))) for c in combos]


def answer_key(family_index: int, params: Dict[str, Any]) -> tuple:
    """Hashable identity of one expected answer."""
    return (family_index, tuple(sorted(params.items())))
