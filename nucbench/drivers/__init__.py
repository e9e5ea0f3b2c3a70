"""Drivers: the general code a traffic file names by ``driver``.  Each makes
its cell's inputs from the seed (``setup``), drives the measured window
(``measure``), reports its totals (``summary``) and compares what the window
produced with the plain reference (``check``); ``probe`` is an optional
measurement made before the window of a traced run."""
