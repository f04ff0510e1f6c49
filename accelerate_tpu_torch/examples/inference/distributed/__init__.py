"""Work-sharded inference (the reference's
`examples/inference/distributed/`): each process takes its
`PartialState.split_between_processes` slice of the inputs, runs the whole
model on it, and `utils.operations.gather_object` reassembles the results.
At one process the split is the identity."""
