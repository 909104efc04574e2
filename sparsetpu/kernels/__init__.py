import jax


def interpret() -> bool:
    """Whether a Pallas kernel runs in interpret mode: on the CPU backend
    (tests) it does; on a GPU it is compiled.  Any other backend raises,
    so a kernel can never fall back to the interpreter on an accelerator
    without saying so."""
    backend = jax.default_backend()
    if backend == "cpu":
        return True
    if backend == "gpu":
        return False
    raise RuntimeError(f"no Pallas route for backend {backend!r}")
