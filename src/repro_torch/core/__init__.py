"""The Two-Chains core: frames, the GOT, jam and ried packages, function
injection, mailboxes, transport telemetry."""
