"""Plain float32 PyTorch references of the benchmark's configurations, one
module a configuration kind, named by a configuration file's "reference"
key. They import nothing of the program under test."""
