"""Caption decoding: greedy and beam search."""
