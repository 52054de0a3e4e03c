from .waterfilling import waterfilling
