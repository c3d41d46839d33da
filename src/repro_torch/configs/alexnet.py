"""AlexNet — the paper's primary workload (Table I, Figs. 1/6/12)."""
ARCH = "alexnet"
INPUT_RES = 227
