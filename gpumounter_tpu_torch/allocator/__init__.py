"""The allocator: slave pods that hold GPUs in the scheduler's books."""
