"""Backend-agnostic core: values, types, schema, graph API, PGDS SPI.

Mirrors the reference's ``okapi-api`` + ``okapi-trees`` modules
(ref: okapi-api/src/main/scala/org/opencypher/okapi/api/,
 okapi-trees/src/main/scala/org/opencypher/okapi/trees/).
"""
