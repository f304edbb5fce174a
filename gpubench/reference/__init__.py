"""Plain float32 references of the benchmark's configurations. They
import nothing of the program."""
