"""setup_s (s): process start to the first timed call (imports, weights
on the card, the facade, the clips, the warm-up calls; on a checkout's
first run the kernels' nvcc builds), less the seconds the plain reference
spends scoring a few clips to set the blank biases (the driver's
`reference_s`, printed on standard error)."""


def read(run):
    return run.setup_s
