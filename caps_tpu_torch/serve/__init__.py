"""The serving tier's failure classifier — the minimal copy the fused
executor needs.  The rest of ``caps_tpu/serve`` is not ported yet
(ROADMAP)."""
