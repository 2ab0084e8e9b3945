"""Expansion schedules over the node domain (single device; the
multi-GPU schedules wait for ROADMAP Queue 1 item 12)."""
