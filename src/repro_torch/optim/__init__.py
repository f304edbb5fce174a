"""The port's optimizer (`adamw`) and int8 gradient compression
(`compression`)."""
