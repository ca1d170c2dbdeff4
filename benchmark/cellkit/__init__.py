"""The benchmark harness: cells, scene and state, the driven program, traces, work counts and the comparison."""
