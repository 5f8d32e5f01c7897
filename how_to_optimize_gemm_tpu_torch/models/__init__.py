"""The Llama-style decoder whose linears run on the quantized kernels."""
