"""VGG-16 — the paper's second workload (Table I, Fig. 6)."""
ARCH = "vgg16"
INPUT_RES = 224
