"""Device models the planner reads (the H100's roofline terms)."""
