"""Plain PyTorch references of the benchmark's configurations.  They
import nothing of the port: they read its outputs only to judge them, and
work out again, from the inputs the benchmark made, what the port
derived."""
