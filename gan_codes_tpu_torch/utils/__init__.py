"""Host-side helpers of the port: image files, seeding, device selection."""
