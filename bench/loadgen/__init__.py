"""Load generators, one module a kind of traffic: ``run(run)`` sets up
the program, warms it up and drives the measured window; ``check(run)``
frees the program's state and returns the compared numbers."""
