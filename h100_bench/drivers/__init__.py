"""Traffic drivers: `run(ctx) -> core.Window`, one module per driver
named by a traffic mix's `driver` key."""
