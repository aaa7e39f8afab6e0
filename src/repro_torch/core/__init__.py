"""The port's PIR core: DPF, primitives, protocols and the server."""
