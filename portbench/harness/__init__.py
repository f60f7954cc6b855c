"""The harness: cell resolution, environment, tracing, weights, checks and
the result line.  Nothing here imports the port at module level."""
