"""The port's benchmark (``python3 bench/run.py``): cells, configurations,
traffic, metrics and the plain references that judge the program."""
