"""The plain-columnar oracle backend (SURVEY.md §7 step 4's reference
backend): Python-list columns with exact Cypher value semantics.  It stands
in for the reference's ``SparkTable`` as the parity oracle in tests; the
TPU backend is differential-tested against it.
"""
