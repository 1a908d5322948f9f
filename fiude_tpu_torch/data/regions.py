"""US region geography shared by the data pipeline.

The port's own copy of ``fiude_tpu/data/regions.py`` (the port imports
nothing of the JAX package): state-code/name maps and the HHS region ->
state assignment used for population-weighted aggregation (reference
``lib/regional_data_builder.py:22,35-44``).  The reference's quirks stay for
parity: MT is listed in both Region 1 and Region 8, and FL, which has query
and population files but no column in the state ILI table, is in no state
list (49 states, DC included) but in Region 4.
"""

STATE_CODE_TO_NAME = {
    'AK': 'Alaska', 'AL': 'Alabama', 'AR': 'Arkansas', 'AZ': 'Arizona',
    'CA': 'California', 'CO': 'Colorado', 'CT': 'Connecticut',
    'DE': 'Delaware', 'DC': 'District of Columbia', 'GA': 'Georgia',
    'HI': 'Hawaii', 'ID': 'Idaho', 'IL': 'Illinois', 'IN': 'Indiana',
    'IA': 'Iowa', 'KS': 'Kansas', 'KY': 'Kentucky', 'LA': 'Louisiana',
    'ME': 'Maine', 'MD': 'Maryland', 'MI': 'Michigan', 'MN': 'Minnesota',
    'MS': 'Mississippi', 'MO': 'Missouri', 'MT': 'Montana', 'NE': 'Nebraska',
    'NV': 'Nevada', 'NH': 'New Hampshire', 'NJ': 'New Jersey',
    'NM': 'New Mexico', 'NY': 'New York', 'NC': 'North Carolina',
    'ND': 'North Dakota', 'OH': 'Ohio', 'OK': 'Oklahoma', 'OR': 'Oregon',
    'PA': 'Pennsylvania', 'RI': 'Rhode Island', 'SC': 'South Carolina',
    'SD': 'South Dakota', 'TN': 'Tennessee', 'TX': 'Texas', 'UT': 'Utah',
    'VT': 'Vermont', 'VA': 'Virginia', 'WA': 'Washington',
    'WV': 'West Virginia', 'WI': 'Wisconsin', 'WY': 'Wyoming',
}

STATE_CODES = list(STATE_CODE_TO_NAME)
STATE_NAMES = list(STATE_CODE_TO_NAME.values())

#: HHS region -> member state codes (reference lib/regional_data_builder.py:35-44)
HHS_REGION_STATES = {
    1: ['CT', 'ME', 'MT', 'NH', 'RI', 'VT'],
    2: ['NY', 'NJ'],
    3: ['DE', 'MD', 'PA', 'VA', 'WV', 'DC'],
    4: ['AL', 'FL', 'GA', 'KY', 'MS', 'NC', 'SC', 'TN'],
    5: ['IL', 'IN', 'OH', 'MI', 'MN', 'WI'],
    6: ['AR', 'LA', 'NM', 'OK', 'TX'],
    7: ['IA', 'KS', 'MO', 'NE'],
    8: ['CO', 'MT', 'ND', 'SD', 'UT', 'WY'],
    9: ['AZ', 'CA', 'HI', 'NV'],
    10: ['AK', 'ID', 'OR', 'WA'],
}

N_REGIONS = {"US": 1, "hhs": 10, "state": 49}
