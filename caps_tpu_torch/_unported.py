"""The one error every feature outside the ported slice raises."""


def not_ported(feature: str) -> NotImplementedError:
    """``raise not_ported("...")`` where the JAX package would run a
    feature this package has no counterpart for yet."""
    return NotImplementedError(f"{feature}: not yet ported, see ROADMAP")
