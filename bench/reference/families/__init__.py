"""The reference's model families, a file each: `reference.models`
finds `<family>.py` here by the name a configuration's "as_run" group
gives."""
