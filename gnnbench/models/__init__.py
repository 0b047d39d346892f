"""Adapters from a configuration to the program, one file a model kind
(``models/<kind>.py``): the port's entry points, where its models call
``spmm`` (for the trace's span), and the step's work counted from shapes."""
