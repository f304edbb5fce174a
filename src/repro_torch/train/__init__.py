"""The port's LM training: the train step (`step`) and the fault-tolerant
loop around it (`trainer`)."""
