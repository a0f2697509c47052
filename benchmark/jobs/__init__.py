"""The jobs that run the traffic mixes, one a kind of work; a mix names its job."""
