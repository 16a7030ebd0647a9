"""AdamW and int8 gradient compression (port of ``repro/optim/``)."""
