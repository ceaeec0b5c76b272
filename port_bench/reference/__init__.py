"""The plain reference the benchmark holds the program to: plain PyTorch in
float32, importing nothing of the program or of JAX, on weights and inputs
the benchmark draws itself."""
