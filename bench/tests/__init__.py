"""The benchmark's own tests: on the CPU at small sizes, apart from the port's tests under tests/."""
