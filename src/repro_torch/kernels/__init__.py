"""The port's kernels: a wrapper per hand-written CUDA kernel, each beside
its plain PyTorch version, plus scheme dispatch (``ops``) and the build
(``_build``). Importing builds nothing; a kernel is compiled at its first
launch. A wrapper takes the plain version only for CPU tensors."""
