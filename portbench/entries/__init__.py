"""The program's entry points that a cell can drive, one module each
(``prepare``, ``call``, ``judge``, ``control``), found by the name in the
cell's traffic file."""
