"""Program drivers, one per model family: each builds the port's model of a
configuration file, its weights from the run's seed, and its train step.
`configs/<config>.json` names its family; `reference/<family>.py` is the
family's plain reference."""
