"""Host-side mask post-processing."""
