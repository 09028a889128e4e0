"""The drivers of the benchmark's traffic kinds, one module a kind: a
traffic file's ``kind`` names its module here."""
